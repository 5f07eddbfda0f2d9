"""Environment registry: dotted names from the directory structure
(``.../environments/locomotion/ant/cuda/__init__.py`` ->
``locomotion.ant.cuda``); leaf ``__init__.py`` files self-register."""

import os

_environments = {}


def extract_environment_name_from_file(file_path, package_marker="environments"):
    parts = os.path.normpath(os.path.dirname(file_path)).split(os.sep)
    idx = len(parts) - 1 - parts[::-1].index(package_marker)
    return ".".join(parts[idx + 1:])


class Environment:
    def __init__(self, name, get_default_config, create_env, general_properties):
        self.name = name
        self.get_default_config = get_default_config
        self.create_env = create_env
        self.general_properties = general_properties


def register_environment(name, get_default_config, create_env, general_properties):
    _environments[name] = Environment(name, get_default_config, create_env, general_properties)


def get_environment_config(environment_name):
    return _environments[environment_name].get_default_config(environment_name)


def get_environment_create_env(environment_name):
    return _environments[environment_name].create_env


def get_environment_general_properties(environment_name):
    return _environments[environment_name].general_properties


def registered_environment_names():
    return sorted(_environments)
