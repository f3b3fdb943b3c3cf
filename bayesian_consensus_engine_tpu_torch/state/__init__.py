"""Reliability state layer of the port: the SQLite checkpoint backend, the
device-tensor store, and the shared scalar decay/update math."""
