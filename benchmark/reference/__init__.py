"""Plain PyTorch references of the benchmark's configurations, one module
per architecture (a configuration's ``architecture``).  Nothing here
imports the program."""
