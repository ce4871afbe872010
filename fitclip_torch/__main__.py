"""``python -m fitclip_torch command=evaluate encoder=... data=...``: the port's CLI
(``cli/main.py``)."""

from fitclip_torch.cli.main import main

if __name__ == "__main__":
    main()
