"""Continuous-batched serving over a paged, compressed KV pool (the port of
``repro.serving``: engine, page pool, admission, the multi-replica router
and the serving fault drill)."""
