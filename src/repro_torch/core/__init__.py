"""Host planning and the single-device solve path of the port."""
