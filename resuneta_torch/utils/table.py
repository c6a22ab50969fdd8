"""Minimal PrettyTable-style ASCII table (resuneta_tpu/utils/table.py; the
reference prints a per-epoch per-task table via prettytable,
train_ISPRS.py:220-276)."""


def ascii_table(title, field_names, rows):
    cols = [list(map(str, [name] + [r[i] for r in rows]))
            for i, name in enumerate(field_names)]
    widths = [max(len(s) for s in col) for col in cols]

    def line(ch="-", joint="+"):
        return joint + joint.join(ch * (w + 2) for w in widths) + joint

    def fmt_row(values):
        return "| " + " | ".join(str(v).ljust(w)
                                 for v, w in zip(values, widths)) + " |"

    out = []
    total_w = len(line())
    out.append(line())
    out.append("|" + title.center(total_w - 2) + "|")
    out.append(line())
    out.append(fmt_row(field_names))
    out.append(line("="))
    for r in rows:
        out.append(fmt_row(r))
    out.append(line())
    return "\n".join(out)
