"""The benchmark's plain reference: a frozen plain-PyTorch iLEQG bank
(:mod:`portbench.reference.ileqg`) and one plain model a file under
``models/``, found by the name a configuration gives.  It imports nothing
of the program."""
