"""Command-line launchers (`serve`, `train`, `dryrun`) and the meshes
they plan for (`mesh`)."""
