"""Erasure-code plugin registry.

Equivalent of the reference's ErasureCodePluginRegistry (src/erasure-code/
ErasureCodePlugin.{h,cc}): a process-wide singleton that loads plugins by
name, performs a version handshake, and exposes ``factory()`` as the one
entry point consumers (the EC backend, the monitor's profile validation, the
benchmark CLI) use.  The reference dlopens ``libec_<name>.so`` and resolves
``__erasure_code_version`` / ``__erasure_code_init``
(ErasureCodePlugin.cc:120-178); here a plugin is a Python module — in-tree
under ``ceph_tpu_torch.ec.plugins.<name>`` or out-of-tree as ``ec_<name>.py`` in
``erasure_code_dir`` — that exposes the same two hooks:

    def __erasure_code_version__() -> str        # must equal PLUGIN_ABI_VERSION
    def __erasure_code_init__(name, registry)    # must registry.add(name, plugin)

This is the port's own singleton, a copy of ceph_tpu.ec.registry: its
in-tree plugins are ``jerasure``, ``isa``, ``shec``, ``lrc``, ``clay`` and the
``xor`` test codec (CPU), and ``cuda`` (the GPU kernels).

Where the reference's ``factory(plugin, directory, profile)`` ends, the port's
takes a ``device``, and a plugin's ``factory(profile, device=None)`` does too.
It names where a ``plugin=cuda`` codec computes ("cuda:N", "cpu"; None = the
plugin's own default, the current CUDA device).  It travels beside the
profile, never in it, so a persisted profile stays byte-equal to the
reference's; the layered plugins (lrc's layers, clay's mds/pft) pass it on to
the codecs they build through the registry, and host-only plugins ignore it.
The OSD passes its ``osd_ec_device``; the monitor, which only checks and
completes profiles, passes "cpu", so it needs no card.

Like the reference:
  * version mismatch -> -EXDEV (ErasureCodePlugin.cc:141-153);
  * init that does not register -> -EBADF equivalent;
  * factory() re-validates that the produced codec's profile round-trips
    (ErasureCodePlugin.cc:108-112);
  * the registry lock is held across load so a hanging plugin blocks (the
    reference tests this non-reentrancy explicitly,
    TestErasureCodePlugin.cc:31-76).
"""

from __future__ import annotations

import errno
import importlib
import importlib.util
import os
import threading
from typing import Dict, Optional

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec.interface import (
    ErasureCodeError,
    ErasureCodeInterface,
    ErasureCodeProfile,
)

VERSION_HOOK = "__erasure_code_version__"
INIT_HOOK = "__erasure_code_init__"


class ErasureCodePlugin:
    """Base class for plugin objects; subclasses implement factory()."""

    def factory(self, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: Dict[str, ErasureCodePlugin] = {}
        self.disable_dlclose = False  # parity knob; unused in-module

    # -- registration -------------------------------------------------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        if name in self._plugins:
            raise ErasureCodeError(-errno.EEXIST, f"plugin {name} already registered")
        self._plugins[name] = plugin

    def get(self, name: str) -> Optional[ErasureCodePlugin]:
        return self._plugins.get(name)

    def remove(self, name: str) -> None:
        self._plugins.pop(name, None)

    # -- loading ------------------------------------------------------------

    def load(self, name: str, directory: str = "") -> ErasureCodePlugin:
        """Resolve, version-check, and init the plugin module.  Caller must
        hold self._lock (mirrors the reference's locked load path)."""
        module = self._resolve_module(name, directory)
        version_fn = getattr(module, VERSION_HOOK, None)
        if version_fn is None:
            raise ErasureCodeError(
                -errno.ENOENT, f"plugin {name}: missing {VERSION_HOOK}"
            )
        version = version_fn()
        if version != PLUGIN_ABI_VERSION:
            raise ErasureCodeError(
                -errno.EXDEV,
                f"plugin {name} version {version} != expected {PLUGIN_ABI_VERSION}",
            )
        init_fn = getattr(module, INIT_HOOK, None)
        if init_fn is None:
            raise ErasureCodeError(-errno.ENOENT, f"plugin {name}: missing {INIT_HOOK}")
        rc = init_fn(name, self)
        if rc not in (None, 0):
            raise ErasureCodeError(int(rc), f"plugin {name}: init failed ({rc})")
        plugin = self._plugins.get(name)
        if plugin is None:
            raise ErasureCodeError(
                -errno.EBADF, f"plugin {name}: init did not register itself"
            )
        return plugin

    def _resolve_module(self, name: str, directory: str):
        if directory:
            path = os.path.join(directory, f"ec_{name}.py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(f"ec_{name}", path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                return module
        try:
            return importlib.import_module(f"ceph_tpu_torch.ec.plugins.{name}")
        except ImportError as e:
            raise ErasureCodeError(
                -errno.ENOENT, f"plugin {name} not found ({e})"
            ) from e

    # -- the one consumer entry point ---------------------------------------

    def factory(
        self,
        plugin_name: str,
        directory: str,
        profile: ErasureCodeProfile,
        device=None,
    ) -> ErasureCodeInterface:
        """Load (if needed) and instantiate a codec on `device` (see the
        module docstring); re-validate that the instantiated codec's
        completed profile is a superset of the request (the reference
        errors if the normalized profile differs,
        ErasureCodePlugin.cc:108-112)."""
        with self._lock:
            plugin = self._plugins.get(plugin_name)
            if plugin is None:
                plugin = self.load(plugin_name, directory)
        codec = plugin.factory(dict(profile), device=device)
        got = codec.get_profile()
        for key, value in profile.items():
            if key in ("directory",):
                continue
            if got.get(key) != value:
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"profile {key}={value!r} was changed to {got.get(key)!r} "
                    f"by plugin {plugin_name}",
                )
        return codec

    def preload(self, plugins: str, directory: str = "") -> None:
        """Load a comma-separated plugin list at daemon start (reference
        preload of osd_erasure_code_plugins, ErasureCodePlugin.cc:180-196)."""
        with self._lock:
            for name in filter(None, (p.strip() for p in plugins.split(","))):
                if name not in self._plugins:
                    self.load(name, directory)


# Process-wide singleton, like the reference's instance().
registry = ErasureCodePluginRegistry()
