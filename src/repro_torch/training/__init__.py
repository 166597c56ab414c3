"""Training (port of `repro.training`): the BranchyNet joint loss, AdamW
with warmup-cosine schedule and global-norm clipping, the train and eval
steps for every zoo architecture, and msgpack checkpoints. `state_specs`
(optimizer sharding) waits for the dry-run tooling (ROADMAP.md queue 1
item 7e)."""
