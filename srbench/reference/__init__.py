"""Plain PyTorch references: no part of the program is imported here."""
