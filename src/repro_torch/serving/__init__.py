"""Serving: engine with prefill/decode over full-length caches, and the
slot-based continuous batcher."""
