"""Model zoo of the port: GPT-J (``gptj``) and per-token sampling."""
