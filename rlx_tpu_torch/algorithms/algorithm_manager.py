"""Algorithm registry: dotted names from the directory structure
(``.../algorithms/ppo/cuda/__init__.py`` -> ``ppo.cuda``); leaf
``__init__.py`` files self-register on import."""

import os

_algorithms = {}


def extract_algorithm_name_from_file(file_path, package_marker="algorithms"):
    parts = os.path.normpath(os.path.dirname(file_path)).split(os.sep)
    idx = len(parts) - 1 - parts[::-1].index(package_marker)
    return ".".join(parts[idx + 1:])


class Algorithm:
    def __init__(self, name, get_default_config, get_model_class, general_properties):
        self.name = name
        self.get_default_config = get_default_config
        self.get_model_class = get_model_class
        self.general_properties = general_properties


def register_algorithm(name, get_default_config, get_model_class, general_properties):
    _algorithms[name] = Algorithm(name, get_default_config, get_model_class, general_properties)


def get_algorithm_config(algorithm_name):
    return _algorithms[algorithm_name].get_default_config(algorithm_name)


def get_algorithm_model_class(algorithm_name):
    return _algorithms[algorithm_name].get_model_class


def get_algorithm_general_properties(algorithm_name):
    return _algorithms[algorithm_name].general_properties


def registered_algorithm_names():
    return sorted(_algorithms)
