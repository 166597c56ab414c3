"""Training (port of `repro.training`): the BranchyNet joint loss, AdamW
with warmup-cosine schedule and global-norm clipping, and the train and
eval steps for the convnet. `state_specs` (optimizer sharding) and the
checkpoint module wait for the launch slice."""
