"""Serving drivers: RAG serving (authorized retrieval, then the generator
LM's prefill and decode) in ``serve.py``."""
