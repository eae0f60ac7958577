"""Training of the port's LM stack: optimizers (``optim``), the train step
(``step``) and the fault-tolerant trainer (``loop``)."""
