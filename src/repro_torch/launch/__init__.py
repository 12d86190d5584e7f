"""Launch layer: meshes (one card so far)."""
