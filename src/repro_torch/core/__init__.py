"""AQPIM core: PQ math, importance weights, KV caches and cache policies."""
