"""launches.train: kernel-launch calls a train step (cudaLaunchKernel,
cuLaunchKernel and their Ex forms), counted from the profiler's host-side
runtime events over the traced segment, which it records whether or not
it keeps the device events; moves train_img_per_s."""


def read(record):
    if not record or not record["segment"]["launches"]:
        return None
    return record["segment"]["launches"] / record["segment_steps"]
