"""One driver per kind of traffic: ``setup(spec, seed, device, spans)``
returns the cell, whose ``unit(i)`` is one unit of the timed work.  A
traffic mix names its driver and holds its parameters."""
