"""Device programs over resident slot-major blocks, on one card or a mesh."""
