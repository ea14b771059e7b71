"""Kinds of answer, one module per kind, found by the ``KIND`` name of an
op (``kinds/<KIND>.py``): the numbers that decide ``correct``, each
answer of the program held against the plain reference's answer to the
same request.

A kind module has:

* ``compare(answer, ref) -> dict``: its numbers by name.  A
  configuration's ``limits`` say which of them are compared and at what
  limit; the others are printed by ``benchmark/calibrate.py`` only;
* ``REFERENCE``: the dtype the plain reference computes in;
* ``CONTROL``: the same reference one precision lower, below what the
  configurations state, which ``benchmark/calibrate.py`` puts in the
  program's place.
"""
