"""Operations and bytes of one call of each registry kernel, by file:
``<registry name>.py`` holds ``record(args, kwargs)``, which keeps what a
call's count needs without reading the device, and ``count(rec)``, which
returns (operations, bytes, dtype name): each input read once, each
output written once."""
