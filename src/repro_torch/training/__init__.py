"""Training (port of `repro.training`): the BranchyNet joint loss, AdamW
with warmup-cosine schedule and global-norm clipping, the train and eval
steps for every zoo architecture, msgpack checkpoints, and the ZeRO-1
moment specs (`optim.state_specs`) that `launch.dryrun` lays out over a
described mesh."""
