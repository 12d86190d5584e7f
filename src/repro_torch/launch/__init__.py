"""Launch layer: meshes (one card so far), the elastic control plane, the
training driver, and the dry-run grid (``cells``, ``dryrun``)."""
