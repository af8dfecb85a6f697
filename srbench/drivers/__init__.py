"""One driver per entry family of the program, named by a cell's file.

A driver module holds ``Driver(config, cell, seed, device)`` with:
``setup()`` (inputs and weights from the seed, then a warm-up on the
cell's own shapes), ``prepare_inputs()`` (the inputs alone, for the
control), ``run_window(seconds)`` (the timed path; steps ``self.tracer``
once per unit when the run is traced), ``end_to_end()``,
``layer_context()`` (what the per-layer readers read besides the trace),
``expected_launches()`` (the port's kernel launches per unit, for the
tracer's completeness rule), ``describe()`` (one line for standard
error), ``release()`` (frees the program's state), ``check()`` (the
readings compared with the plain reference), ``control(calls)`` (the
control's readings; after ``setup()`` and a window where the class sets
``CONTROL_AFTER_WINDOW``) and the counts ``attempted`` and ``failed``.
"""
