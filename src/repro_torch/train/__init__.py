"""Step factories of the port: the serving steps (training is ROADMAP
Queue A item 13b)."""
