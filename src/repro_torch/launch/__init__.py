"""Launch layer: meshes and the ranks that hold them (``mesh``, ``ranks``),
the elastic control plane, the training driver, and the dry-run grid
(``cells``, ``dryrun``)."""
