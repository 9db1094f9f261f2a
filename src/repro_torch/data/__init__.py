"""Host-side inputs: tokenizer and the synthetic query/tweet stream."""
