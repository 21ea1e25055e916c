"""OCR helpers shared with the query language.

Only the text folding of ``ocr/glyphs.py`` (used by the ``ocr:`` query
operator) is carried over so far; the recognizer itself waits
(ROADMAP.md, queue 1).
"""

OCR_TAG = "ocr_text"
