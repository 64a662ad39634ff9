"""App hosting: real application code on the CPU, transport on the device.

Counterpart of ``shadow_tpu/hosting/``: hosted apps implement
:class:`HostedApp` callbacks against a :class:`HostOS` syscall surface;
the engine records their wakes in the device wake ring and replays their
syscall batches into device state between lookahead windows
(``hosting.bridge``, ``hosting.runtime``). C plugins (``hosting.cplugin``)
and unmodified binaries behind the LD_PRELOAD shim (``hosting.shim``)
use the same surface. The registry is the port's own.
"""

from .api import HostOS, HostedApp, Sock, register, lookup

__all__ = ["HostOS", "HostedApp", "Sock", "register", "lookup"]
