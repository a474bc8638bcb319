"""The frozen yardstick: data, the exact reference, the plain loop, the
peaks and the comparison that decides ``correct``. Plain torch and numpy;
it imports nothing of the program."""
