"""Text query language: tokenizer + prefix-operator parser."""

from pixelbox_tpu_torch.query.tokenizer import tokenize_query, QueryTokenizeError
from pixelbox_tpu_torch.query.parser import parse_query, ParsedQuery

__all__ = ["tokenize_query", "QueryTokenizeError", "parse_query", "ParsedQuery"]
