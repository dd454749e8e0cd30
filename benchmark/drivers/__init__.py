"""One driver per kind of cell, named by the configuration's ``driver``
key: each sets up the program, measures the window and checks what the
timed path produced against the reference."""
