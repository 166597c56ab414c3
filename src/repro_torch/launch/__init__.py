"""Launch entry points (port of `repro.launch`): the serving steps, the
training entry point, and the one-card dry run with its described meshes
and step cost model."""
