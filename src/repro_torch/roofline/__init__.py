"""Analytic roofline pricing of SpMV plans and assembly strategies
(``cost_model``), with this port's card as the denominator."""
