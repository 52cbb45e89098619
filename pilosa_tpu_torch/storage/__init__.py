"""Storage helpers: string-key translation (``translate``) and id
allocation with reserve/commit sessions (``idalloc``)."""
