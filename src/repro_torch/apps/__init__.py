"""Applications built on the port's SPD stream-computing core."""
