"""Plain float32 reference of what a step computes; imports no part of
the program."""
