"""Step accounting of the port (the port of ``repro.analysis``): the H100's
peaks and the three-term roofline (:mod:`.roofline`), and the per-device count
of one step's FLOPs, bytes, collectives, memory and kernel calls
(:mod:`.opstats`)."""
