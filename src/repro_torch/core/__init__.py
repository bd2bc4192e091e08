"""The split-learning system on the host: orbits, links, energy,
problem (13), the SL step and pass, and the constellation ring."""
