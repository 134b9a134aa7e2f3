"""One module per traffic driver, found by the ``driver`` a traffic mix
names. A mix is a data file; its driver is the general generator that
reads it. Each driver defines ``Driver(cell, model, entry, seed, device)``
with ``prepare``, ``inputs``, ``call``, ``units``, ``after``, ``work``,
``close`` and ``check`` (see ``harness.runner``)."""
