"""The training and serving steps of the port (``step``), the training
loop (``loop``) and the GPipe pipeline over the ranks of a process group
(``pipeline``)."""
