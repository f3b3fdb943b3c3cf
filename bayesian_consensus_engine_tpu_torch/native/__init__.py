"""The port's C extensions (``fastpack.c``, ``internmap.c``) and their build."""
