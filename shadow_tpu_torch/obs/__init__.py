"""Observability of a run: the determinism digest chain (``digest``),
the network observatory (``netscope``), pcap capture (``pcap``),
heartbeats (``tracker``, ``logger``), spans (``trace``), the metrics
registry (``metrics``), phase attribution (``perf``), the perf ledger
(``ledger``) and the memory watermark (``memscope``)."""
