"""The share of samples the gate refused and sent to the cloud partition
(`EngineStats.offloaded / requests`)."""


def read(record):
    stats = record["stats"]
    if not stats or not stats["requests"]:
        return None
    return 100.0 * stats["offloaded"] / stats["requests"]
