"""The package's former name, kept as an alias of :mod:`rustic`.

Existing imports and ``python -m <this package>.cli`` keep working:
this package and each of its submodules resolve to the very module
objects of :mod:`rustic`, so nothing is loaded twice.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import rustic

_ALIAS = __name__


def _target(fullname):
    return "rustic" + fullname[len(_ALIAS):]


class _AliasImporter(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.x.y`` to the already importable ``rustic.x.y``."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_ALIAS + "."):
            return None
        real = importlib.util.find_spec(_target(fullname))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None,
        )

    def create_module(self, spec):
        module = importlib.import_module(_target(spec.name))
        # the import system stamps the alias spec on the module; keep the
        # real one so reloads and pickling see `rustic.x.y`
        self._specs[id(module)] = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = self._specs.pop(id(module), module.__spec__)

    def get_code(self, fullname):  # `python -m <alias>.cli`
        real = importlib.util.find_spec(_target(fullname))
        return real.loader.get_code(real.name)


sys.meta_path.insert(0, _AliasImporter())
sys.modules[_ALIAS] = rustic
