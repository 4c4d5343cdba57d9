"""Seeded synthetic inputs with exact ground truth: camera sequences
(``scenes``) and long-session solver problems (``problems``)."""
