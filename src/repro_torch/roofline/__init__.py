"""Analytic roofline pricing of SpMV plans and assembly strategies
(``cost_model``), with this port's card as the denominator; the LM
roofline per cell (``analysis``) and the flop and collective counts of
what torch runs (``op_cost``)."""
