"""Training on one card: AdamW (``optimizer``), the train step
(``train_loop``) and int8 gradient compression (``grad_compression``)."""
