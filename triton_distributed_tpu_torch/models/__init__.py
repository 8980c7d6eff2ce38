"""Qwen3 model, KV caches, weight conversion and the serving engine."""
