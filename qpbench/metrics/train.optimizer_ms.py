"""train.optimizer_ms: the device time of the optimizer step (clip and
Adam, ``train/optimizer`` span) an update, ms."""


def read(run):
    if not run.calls:
        return None
    return 1e3 * run.device_s("train/optimizer") / len(run.calls)
