"""The analytic roofline: the H100's data-sheet peaks (``hw``), the three
roofline terms (``analysis``) and the per-cell FLOP, byte and matmul
formulas with the OISMA engine's projection (``model``)."""
