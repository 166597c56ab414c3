"""Datasets (port of `repro.data`)."""
