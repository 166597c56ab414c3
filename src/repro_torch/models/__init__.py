"""Models (port of `repro.models`): B-AlexNet so far."""
