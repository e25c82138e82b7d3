"""host_issue_ms.stream: host ms of a detect call of the camera stream,
from the call to its return before the synchronize, the median over the
window's calls; moves stream_p95_ms."""

import statistics


def read(record):
    if not record or not record["host_issue_ms"]:
        return None
    return statistics.median(record["host_issue_ms"])
