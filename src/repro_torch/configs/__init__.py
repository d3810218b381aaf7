"""Design points of the port (``configs.onn``)."""
