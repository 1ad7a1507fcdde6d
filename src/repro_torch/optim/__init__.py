"""AdamW and gradient compression over the port's parameter trees (port of
``repro.optim``)."""
