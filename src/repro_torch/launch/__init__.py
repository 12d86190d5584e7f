"""Launch layer: meshes (one card so far), the elastic control plane and the
training driver."""
