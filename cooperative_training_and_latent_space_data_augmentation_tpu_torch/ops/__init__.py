"""Conv ops of the port: kernel K1 (the CHW 3x3 conv) and its dispatcher, STN input construction."""
