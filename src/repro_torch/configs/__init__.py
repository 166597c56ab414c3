"""Model configurations (port of `repro.configs`)."""
