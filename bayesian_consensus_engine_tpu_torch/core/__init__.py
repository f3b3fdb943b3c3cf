"""Host packing layer of the port (``core/batch.py``)."""
