"""The benchmark's harness: finding a cell's parts by name (``spec``), the
traffic runners (``progressive_still``), the traced chunk (``trace``), the
comparison with the plain reference (``check``) and one run (``runner``)."""
