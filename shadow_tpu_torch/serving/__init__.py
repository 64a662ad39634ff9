"""Serving: same-shape scenarios run as lanes of one program, the
disk tier of the port's native code, and the fleet's pre-warm.

Counterpart of ``shadow_tpu/serving/``. :mod:`batch` stacks N
scenarios that share one EngineConfig along the row axis, so one drain
pass steps every lane, while each lane keeps its own digest chain,
summary and perf-ledger entry, byte-identical to its run alone
(``python -m shadow_tpu_torch batch``, ``fleet submit --batch``).
:mod:`aotcache` keeps the nvcc-built kernel library on disk
(``--aot-cache``); the captured chunk graphs themselves live in the
process (``core.jitcache``). :mod:`prewarm` builds and captures each
distinct shape of a sweep once before its runs admit (``fleet run
--prewarm``).
"""
