"""Run modes."""


class RunnerMode:
    TRAIN = "train"
