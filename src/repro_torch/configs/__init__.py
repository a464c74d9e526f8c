"""Architecture configs + shapes (--arch/--shape registry) of the port."""
