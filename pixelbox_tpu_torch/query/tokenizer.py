"""Quote/escape-aware query tokenizer.

Port of the reference's tokenizer semantics (src/engine.rs:443-497):

- split on spaces outside quotes;
- ``"..."`` groups words (the quotes are consumed, content kept verbatim
  including spaces);
- ``\\`` escapes the next character (so ``\\"`` yields a literal quote and
  does not toggle quoting);
- empty tokens are dropped;
- a trailing open quote or trailing escape is an error.
"""

from __future__ import annotations

from typing import List


class QueryTokenizeError(ValueError):
    """Raised for a trailing open-quote or trailing escape character."""


def tokenize_query(query: str) -> List[str]:
    spans: List[str] = []
    next_character_escaped = False
    quote_active = False
    active = []

    for ch in query:
        if next_character_escaped:
            active.append(ch)
            next_character_escaped = False
        elif ch == '"':
            if not quote_active:
                quote_active = True
            else:
                quote_active = False
                spans.append("".join(active))
                active = []
        elif ch == "\\":
            next_character_escaped = True
        elif ch == " ":
            if quote_active:
                active.append(" ")
            elif active:
                spans.append("".join(active))
                active = []
        else:
            active.append(ch)

    if quote_active:
        raise QueryTokenizeError("String tokenization failed: trailing open-quote.")
    if next_character_escaped:
        raise QueryTokenizeError(
            "String tokenization failed: trailing escape character."
        )
    if active:
        spans.append("".join(active))
    return spans
