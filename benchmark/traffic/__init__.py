"""One module per kind of traffic (a workload file's ``kind``), each with a
``Session`` that sets the program up for a cell, runs its window, frees
it and checks what it produced against the plain reference."""
