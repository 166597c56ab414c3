"""The edge partition's time per call (`EngineStats.edge_time_s /
edge_calls`: host clock around the call, ended by a sync)."""


def read(record):
    stats = record["stats"]
    if not stats or not stats["edge_calls"]:
        return None
    return 1e3 * stats["edge_time_s"] / stats["edge_calls"]
