"""Run modes."""


class RunnerMode:
    SHOW_CONFIG = "show_config"
    TRAIN = "train"
    TEST = "test"
