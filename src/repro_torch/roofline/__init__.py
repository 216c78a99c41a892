"""Roofline analysis of the port's dry run (``launch/dryrun.py``): chip
specs (``hw``), the three terms (``analysis``), the recorder that counts a
traced step's FLOPs, bytes, collectives and memory (``counter``), and each
hand-written kernel's bytes and operations (``kernel_cost``)."""
