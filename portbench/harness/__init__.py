"""The benchmark's general code: the weights, the trace reader and the run
of one cell.  What belongs to one configuration, traffic mix, driver or
metric lives in the files named after it under ``portbench/configs``,
``mixes``, ``drivers``, ``metrics`` and ``limits``."""
