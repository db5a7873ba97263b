"""Plain PyTorch reference models that decide a run's ``correct``; they import
nothing of the program."""
