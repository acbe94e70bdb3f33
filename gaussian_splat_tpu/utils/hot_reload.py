"""Kernel hot reload: mtime-watched module re-import with last-good fallback.

Port of the reference's shader hot reload
(/root/reference/src/instanced_splat_renderer.mm:285-336): the reference polls
the .metal file's mtime every frame, recompiles the pipeline on change, and
keeps the previous pipeline if compilation fails. Here the "shader" is a Python
module of Pallas kernels: on mtime change we re-import the module, rebuild and
re-jit the render callable, and keep the last good compiled function when the
new code raises (at import, trace, or compile time).
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback
from typing import Callable, Optional


class HotReloader:
    """Watches a module's source file and rebuilds a callable on change.

    Usage:
        reloader = HotReloader(
            module_name="gaussian_splat_tpu.ops.pallas_raster",
            build=lambda module: jax.jit(make_render_fn(module)),
            probe_args=(model, camera),   # used to validate the new build
        )
        fn = reloader.get()   # call every frame; cheap mtime stat
    """

    def __init__(
        self,
        module_name: str,
        build: Callable,
        probe_args: tuple = (),
        verbose: bool = True,
    ):
        self.module_name = module_name
        self.build = build
        self.probe_args = probe_args
        self.verbose = verbose
        self._fn: Optional[Callable] = None
        self._mtime: Optional[float] = None
        module = importlib.import_module(module_name)
        self._path = module.__file__
        self._rebuild(module)
        self._mtime = self._stat()

    def _stat(self) -> float:
        try:
            return os.stat(self._path).st_mtime
        except OSError:
            return self._mtime or 0.0

    def _rebuild(self, module) -> bool:
        """Build + probe-run the new callable. Returns True on success."""
        try:
            fn = self.build(module)
            if self.probe_args:
                import jax

                jax.block_until_ready(fn(*self.probe_args))
            self._fn = fn
            if self.verbose:
                print(f"[hot-reload] {self.module_name} loaded")
            return True
        except Exception:
            # keep the previous compiled fn, like the reference keeps the old
            # pipeline on compile failure (instanced_splat_renderer.mm:330-335)
            if self.verbose:
                print(f"[hot-reload] {self.module_name} FAILED, keeping last good:")
                traceback.print_exc()
            return False

    def check(self) -> bool:
        """Poll mtime; reload if changed. Returns True if a reload happened."""
        mtime = self._stat()
        if mtime == self._mtime:
            return False
        self._mtime = mtime
        try:
            module = importlib.reload(sys.modules[self.module_name])
        except Exception:
            if self.verbose:
                print(f"[hot-reload] re-import of {self.module_name} failed:")
                traceback.print_exc()
            return False
        return self._rebuild(module)

    def get(self) -> Callable:
        self.check()
        if self._fn is None:
            raise RuntimeError(f"no successful build of {self.module_name} yet")
        return self._fn
