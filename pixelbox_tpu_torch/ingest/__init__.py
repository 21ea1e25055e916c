"""Ingest pipeline: crawl → decode → thumbnail/EXIF → embed → quantize → append."""
