"""Observability of a run: the determinism digest chain (``digest``)."""
