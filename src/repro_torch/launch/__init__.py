"""Entry points that run the port end to end (``serve_assist``)."""
