"""Launch entry points (port of `repro.launch`): the serving steps and
the training driver."""
