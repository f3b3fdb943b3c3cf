"""Device programs over resident slot-major blocks (one card so far)."""
