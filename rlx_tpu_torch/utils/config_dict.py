"""Attribute-access config namespaces (plain Python, no ml_collections)."""


class ConfigDict(dict):
    """A dict whose keys are also attributes; nested namespaces are
    ConfigDicts.  Setting an unknown key raises, so a misspelt override
    fails instead of being ignored."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def set_existing(self, name, value):
        if name not in self:
            raise KeyError(f"unknown config key {name!r}")
        self[name] = value

    def to_dict(self):
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v for k, v in self.items()}
