"""The cloud partition's time per call on the refused rows
(`EngineStats.cloud_time_s / cloud_calls`: host clock around the call,
ended by a sync)."""


def read(record):
    stats = record["stats"]
    if not stats or not stats["cloud_calls"]:
        return None
    return 1e3 * stats["cloud_time_s"] / stats["cloud_calls"]
