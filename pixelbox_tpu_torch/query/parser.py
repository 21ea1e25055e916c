"""Prefix-operator query parser.

Port of the reference's where-clause builder (src/engine.rs:499-565) with
the same operators and matching semantics, but emitting **parameterized**
SQL (the reference string-interpolates user text into LIKE clauses and
acknowledges the injection at engine.rs:550-552; binding parameters fixes
that without changing match results, since SQLite LIKE wildcards %/_ inside
the bound value still apply).

Operators (prefix split on the FIRST ':'; prefix is lowercased):

- ``similar:<path>`` — visual-similarity modality: the engine embeds the
  named image and orders results by cosine distance (engine.rs:510-537).
  Contributes no WHERE clause.
- ``exif:<name>:<value>`` / ``tag:<name>:<value>`` — tags.name LIKE %name%
  AND tags.value LIKE %value%; with no second ':' matches name OR value
  (engine.rs:539-547).
- ``all:<text>`` — tags.value OR filename OR path (engine.rs:549-553).
- ``text:<words>`` — semantic text→image search over the BLIP index (the
  capability the reference staged via models/blip-config.json but never
  wired — reference README.md:35 roadmap).  Multiple ``text:`` tokens
  join with spaces.  Contributes no WHERE clause, like ``similar:``.
- ``face:<path>`` — face-similarity search over the face index
  (reference roadmap "Face search", README.md:33).  Contributes no
  WHERE clause, like ``similar:``.
- ``filename:<text>`` — filename LIKE %text%.  NOTE: the reference has an
  apparent bug here (engine.rs:556-558 interpolates the WHOLE token
  including the ``filename:`` prefix, so the operator can never match);
  we match on the remainder, which is the evident intent.
- any other ``prefix:`` — ignored, like the reference (no branch matches
  and the bare-token default only applies to tokens without ':').
- bare token — filename LIKE %token% (engine.rs:560-561).

Clauses are AND-joined (engine.rs:564).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from pixelbox_tpu_torch.query.tokenizer import tokenize_query


@dataclass
class ParsedQuery:
    """A parsed text query: SQL filter + optional similarity modality."""

    where_sql: str = ""          # AND-joined parameterized fragments ('' = no filter)
    params: List[str] = field(default_factory=list)
    similar_path: Optional[str] = None  # from `similar:<path>`, last one wins
    text_query: Optional[str] = None    # from `text:<words>` tokens, space-joined
    face_path: Optional[str] = None     # from `face:<path>`, last one wins
    tokens: List[str] = field(default_factory=list)

    @property
    def has_filter(self) -> bool:
        return bool(self.where_sql)


def _like(fragment_sql: str, values: Tuple[str, ...], clauses, params):
    clauses.append(fragment_sql)
    params.extend(f"%{v}%" for v in values)


def parse_query(user_input: str) -> ParsedQuery:
    tokens = tokenize_query(user_input)
    clauses: List[str] = []
    params: List[str] = []
    similar_path: Optional[str] = None
    face_path: Optional[str] = None
    text_parts: List[str] = []

    for token in tokens:
        if ":" in token:
            magic_prefix, remaining = token.split(":", 1)
            magic_prefix = magic_prefix.lower()
            if magic_prefix == "similar":
                similar_path = remaining
            elif magic_prefix == "face":
                # Face-similarity modality (reference roadmap "Face
                # search", README.md:33): the engine detects the largest
                # face in the named image, embeds its crop, and ranks
                # indexed images by their closest stored face.
                # Contributes no WHERE clause, like `similar:`.
                face_path = remaining
            elif magic_prefix == "text":
                text_parts.append(remaining)
            elif magic_prefix in ("exif", "tag"):
                if ":" in remaining:
                    tag, target = remaining.split(":", 1)
                    _like(
                        "(tags.name LIKE ? AND tags.value LIKE ?)",
                        (tag, target),
                        clauses,
                        params,
                    )
                else:
                    _like(
                        "(tags.name LIKE ? OR tags.value LIKE ?)",
                        (remaining, remaining),
                        clauses,
                        params,
                    )
            elif magic_prefix == "all":
                _like(
                    "(tags.value LIKE ? OR images.filename LIKE ? OR images.path LIKE ?)",
                    (remaining, remaining, remaining),
                    clauses,
                    params,
                )
            elif magic_prefix == "ocr":
                # Text-in-image search (reference roadmap README.md:32-34):
                # matches the fold-normalized OCR tag with the query folded
                # the same way, so template-OCR confusion classes (1/l/I,
                # 0/O, 5/S, ...) don't break recall.
                from pixelbox_tpu_torch.ocr.glyphs import fold_text

                _like(
                    "(tags.name = 'ocr_text_fold' AND tags.value LIKE ?)",
                    (fold_text(remaining),),
                    clauses,
                    params,
                )
            elif magic_prefix == "filename":
                _like("images.filename LIKE ?", (remaining,), clauses, params)
            # Unknown prefixes are silently ignored (reference behavior).
        else:
            _like("images.filename LIKE ?", (token,), clauses, params)

    return ParsedQuery(
        where_sql=" AND ".join(clauses),
        params=params,
        similar_path=similar_path,
        text_query=" ".join(text_parts) if text_parts else None,
        face_path=face_path,
        tokens=tokens,
    )
