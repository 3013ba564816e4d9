"""Chemistry: species and thermo (``mechanism``), CHEMKIN kinetics
(``kinetics``) and chemical-path-diagram edges (``qpd``)."""
