"""Serving: same-shape scenarios run as lanes of one program.

Counterpart of ``shadow_tpu/serving/``. :mod:`batch` stacks N
scenarios that share one EngineConfig along the row axis, so one drain
pass steps every lane, while each lane keeps its own digest chain,
summary and perf-ledger entry, byte-identical to its run alone
(``python -m shadow_tpu_torch batch``, ``fleet submit --batch``).

The reference's executable cache (``aotcache``) and pre-warm pipeline
(``prewarm``) keep compiled XLA programs; eager torch compiles nothing,
so the port has neither. Their counterpart, capturing the window loop
as a CUDA graph, waits for the loop to run on the device (ROADMAP B3),
and ``--aot-cache``/``--prewarm`` are refused until then
(:data:`NO_EXECUTABLE_CACHE`).
"""

NO_EXECUTABLE_CACHE = (
    "eager torch compiles nothing, so there is no executable to cache "
    "or pre-warm; the counterpart, CUDA-graph capture of the window "
    "loop, waits for ROADMAP B3")
