"""AQPIM core: PQ math, importance weights, KV caches, cache policies and
cache layouts."""
