"""device_idle.detect: the share of the traced segment in which no kernel,
copy or fill ran on the card, in %."""


def read(record):
    if not record or record["segment"]["busy_s"] <= 0:
        return None
    seg = record["segment"]
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])
