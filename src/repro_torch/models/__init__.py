"""Models (port of `repro.models`): B-AlexNet and the decoder-only
transformer (dense and vlm families) behind one registry."""
