"""Models (port of `repro.models`): B-AlexNet, the decoder-only stack
(dense, vlm, moe, ssm and hybrid families) and the Whisper-style
encoder-decoder behind one registry."""
