"""Host mesh geometry: the port's copies of OBJ I/O and mesh math."""
