"""The engine's time per batch outside its two partitions: `infer` (host
clock around the call) less `EngineStats.edge_time_s` and `cloud_time_s`,
over the batches: the gate call, `nonzero`, `index_select`, the result
copies and the syncs."""


def read(record):
    stats = record["stats"]
    if not stats or not record["batches"]:
        return None
    rest = sum(record["latencies_s"]) - stats["edge_time_s"] - stats["cloud_time_s"]
    return 1e3 * rest / record["batches"]
