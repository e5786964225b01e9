"""Live curses MMI screen.

Reference: gui.cpp -- a continuously updating ncurses status page
(mode, reflector connection, TX/RX/DP color state, callsigns,
frequencies, RSSI bar with color zones, gui.cpp:115-229) above a
command prompt/response area (gui.cpp:196-213).

The screen redraws ~4x/s on a timeout'd getch loop; typed characters
accumulate into a command line handed to the same Mmi parser that
processes config files.

The port's own copy of ``m17_sdr_tpu.app.curses_view``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

from .dbase import Dbase
from .mmi import Mmi
from .view import render


def live_screen(mmi: Mmi, db: Dbase, signal_fn=None) -> None:
    """Run the interactive curses loop until `q` is entered.

    signal_fn() -> float in [0,1] feeds the bar (gui_bar zones: green
    below 0.6, yellow to 0.85, red above -- gui.cpp:157-190).
    """
    import curses

    def _main(scr) -> None:
        curses.curs_set(1)
        scr.timeout(250)                      # redraw ~4x/s
        if curses.has_colors():
            curses.start_color()
            curses.use_default_colors()
            curses.init_pair(1, curses.COLOR_GREEN, -1)
            curses.init_pair(2, curses.COLOR_YELLOW, -1)
            curses.init_pair(3, curses.COLOR_RED, -1)
        line = ""
        last_resp = ""
        quit_requested = []
        prev_quit = mmi.on_quit
        mmi.on_quit = lambda: quit_requested.append(True)
        try:
            while not quit_requested:
                scr.erase()
                sig = float(signal_fn()) if signal_fn else db.rssi
                text = render(db, signal=sig)
                for y, row in enumerate(text.splitlines()):
                    if row.startswith("["):
                        # color-zoned signal bar (gui.cpp:157-190)
                        fill = row.count("#") / max(len(row) - 10, 1)
                        pair = 1 if fill < 0.6 else (2 if fill < 0.85 else 3)
                        attr = curses.color_pair(pair) \
                            if curses.has_colors() else 0
                        scr.addnstr(y, 0, row, curses.COLS - 1, attr)
                    else:
                        scr.addnstr(y, 0, row, curses.COLS - 1)
                base = text.count("\n") + 2
                scr.addnstr(base, 0, last_resp, curses.COLS - 1)
                scr.addnstr(base + 1, 0, "m17> " + line, curses.COLS - 1)
                scr.refresh()
                ch = scr.getch()
                if ch == -1:
                    continue
                if ch in (10, 13):            # enter
                    if line.strip():
                        last_resp = mmi.parse(line.strip())
                    line = ""
                elif ch in (curses.KEY_BACKSPACE, 127, 8):
                    line = line[:-1]
                elif 32 <= ch < 127:
                    line += chr(ch)
        finally:
            mmi.on_quit = prev_quit

    curses.wrapper(_main)
