"""Device math of the port: the cycle's tensor twins and the settle kernel."""
