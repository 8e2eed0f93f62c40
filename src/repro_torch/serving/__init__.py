"""Serving surface of the port."""
from .engine import LLMEngine

__all__ = ["LLMEngine"]
