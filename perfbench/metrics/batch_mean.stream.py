"""batch_mean.stream: real frames a detect call of the camera stream,
padding excluded, over the window's calls; moves stream_p95_ms."""


def read(record):
    if not record or not record["batches"]:
        return None
    return sum(record["batches"]) / len(record["batches"])
