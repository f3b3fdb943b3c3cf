"""Host utilities of the port: constants, time conversion, interning and
the device/dtype policy."""
