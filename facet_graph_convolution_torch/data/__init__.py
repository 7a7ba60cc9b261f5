"""Host dataset containers and synthetic meshes."""
