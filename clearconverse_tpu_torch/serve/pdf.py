"""From-scratch PDF writer for transcript export.

Replaces the reference's reportlab path (back/api.py:141-288) with a
first-party PDF 1.4 generator reproducing the same script-style layout:
colored "ClearConverse" header, Courier-family typewriter styles,
"Speaker A:" blocks with gray "(1.23s - 4.56s)" timestamps, indented
dialogue, and a "Generated on … | Page N" footer on every page. Uses only
the 14 standard base fonts (no embedding needed), letter pages, and
uncompressed content streams.
"""

from __future__ import annotations

import re
from datetime import datetime
from typing import List, Optional, Tuple

PAGE_W, PAGE_H = 612, 792      # letter, points
MARGIN_L, MARGIN_R = 72, 72
MARGIN_T, MARGIN_B = 72, 72
USABLE_W = PAGE_W - MARGIN_L - MARGIN_R

F_HELV_B = "F1"    # Helvetica-Bold   (header)
F_COUR = "F2"      # Courier          (dialogue/footer)
F_COUR_B = "F3"    # Courier-Bold     (title/speaker)
F_COUR_O = "F4"    # Courier-Oblique  (subtitle/timestamps)

_FONTS = {
    F_HELV_B: "Helvetica-Bold",
    F_COUR: "Courier",
    F_COUR_B: "Courier-Bold",
    F_COUR_O: "Courier-Oblique",
}


def _esc(text: str) -> str:
    """PDF literal-string escape + WinAnsi (cp1252) transcoding.

    Base-14 Type1 fonts with /Encoding /WinAnsiEncoding decode literal
    strings as single cp1252 bytes — encoding the python str as UTF-8
    would render every non-ASCII char as multi-character mojibake
    (reportlab's Type1 path is WinAnsi too). Characters outside cp1252
    (CJK, emoji) fall back to '?' — base fonts have no glyphs for them;
    full coverage would require font embedding."""
    text = text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
    return text.encode("cp1252", errors="replace").decode("latin-1")


def _wrap(text: str, font_size: float, width: float) -> List[str]:
    """Courier is monospaced: glyph width = 0.6 em. Words longer than a
    line hard-break into max_chars chunks (reportlab wraps long words;
    truncating them would silently drop transcript text — URLs, long
    numbers, whisper's repeated-character degenerations)."""
    max_chars = max(int(width / (font_size * 0.6)), 8)
    out: List[str] = []
    for para in text.split("\n"):
        words = para.split()
        line = ""
        for w in words:
            cand = f"{line} {w}".strip()
            if len(cand) <= max_chars:
                line = cand
                continue
            if line:
                out.append(line)
            while len(w) > max_chars:
                out.append(w[:max_chars])
                w = w[max_chars:]
            line = w
        out.append(line)
    return out or [""]


class _Page:
    def __init__(self):
        self.ops: List[str] = []
        self.y = PAGE_H - MARGIN_T

    def text(self, x: float, y: float, font: str, size: float, s: str,
             rgb: Tuple[float, float, float] = (0, 0, 0)) -> None:
        r, g, b = rgb
        self.ops.append(
            f"BT /{font} {size} Tf {r:.3f} {g:.3f} {b:.3f} rg "
            f"{x:.1f} {y:.1f} Td ({_esc(s)}) Tj ET")


class _Doc:
    def __init__(self):
        self.pages: List[_Page] = [_Page()]

    @property
    def page(self) -> _Page:
        return self.pages[-1]

    def need(self, height: float) -> None:
        if self.page.y - height < MARGIN_B:
            self.pages.append(_Page())

    def line(self, font: str, size: float, s: str, indent: float = 0,
             rgb=(0, 0, 0), leading: Optional[float] = None,
             center: bool = False) -> None:
        leading = leading or size * 1.25
        self.need(leading)
        x = MARGIN_L + indent
        if center:
            x = MARGIN_L + (USABLE_W - len(s) * size * 0.6) / 2
        self.page.text(x, self.page.y - size, font, size, s, rgb)
        self.page.y -= leading

    def spacer(self, h: float) -> None:
        self.page.y -= h

    def render(self) -> bytes:
        stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        n_pages = len(self.pages)
        for i, pg in enumerate(self.pages):
            footer = f"Generated on {stamp} | Page {i + 1}"
            x = PAGE_W - MARGIN_R - len(footer) * 8 * 0.6
            pg.text(x, 36, F_COUR, 8, footer, (0.5, 0.5, 0.5))

        objs: List[bytes] = []

        def add(body: bytes) -> int:
            objs.append(body)
            return len(objs)

        font_ids = {}
        for key, base in _FONTS.items():
            font_ids[key] = add(
                f"<< /Type /Font /Subtype /Type1 /BaseFont /{base} "
                f"/Encoding /WinAnsiEncoding >>".encode())
        font_dict = " ".join(f"/{k} {font_ids[k]} 0 R" for k in _FONTS)

        content_ids = []
        for pg in self.pages:
            # latin-1: _esc already transcoded text to cp1252 bytes held as
            # U+0000-U+00FF codepoints; UTF-8 here would re-split them.
            stream = "\n".join(pg.ops).encode("latin-1")
            content_ids.append(add(
                b"<< /Length " + str(len(stream)).encode() + b" >>\nstream\n"
                + stream + b"\nendstream"))

        page_ids_start = len(objs) + 1
        pages_obj_id = page_ids_start + n_pages
        for cid in content_ids:
            add((f"<< /Type /Page /Parent {pages_obj_id} 0 R "
                 f"/MediaBox [0 0 {PAGE_W} {PAGE_H}] "
                 f"/Resources << /Font << {font_dict} >> >> "
                 f"/Contents {cid} 0 R >>").encode())
        kids = " ".join(f"{page_ids_start + i} 0 R" for i in range(n_pages))
        add((f"<< /Type /Pages /Kids [{kids}] /Count {n_pages} >>").encode())
        catalog_id = add((f"<< /Type /Catalog /Pages {pages_obj_id} 0 R >>").encode())

        out = bytearray(b"%PDF-1.4\n")
        offsets = [0]
        for i, body in enumerate(objs, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref_pos = len(out)
        out += f"xref\n0 {len(objs) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root {catalog_id} 0 R >>\n"
                f"startxref\n{xref_pos}\n%%EOF\n").encode()
        return bytes(out)


def generate_transcript_pdf(transcript_text: str, output_path: str,
                            original_filename: Optional[str] = None) -> str:
    """Reference contract (back/api.py:141): transcript text → styled PDF."""
    doc = _Doc()

    # Header: "ClearConverse : Overlapping Speech Transcription" — the
    # reference colors "Clear" blue (#1E90FF) and "Converse" dark gray.
    header = "ClearConverse : Overlapping Speech Transcription"
    x = MARGIN_L + (USABLE_W - len(header) * 14 * 0.55) / 2
    doc.need(20)
    doc.page.text(x, doc.page.y - 14, F_HELV_B, 14, "Clear", (0.118, 0.565, 1.0))
    doc.page.text(x + 5 * 14 * 0.55, doc.page.y - 14, F_HELV_B, 14,
                  "Converse : Overlapping Speech Transcription", (0.267, 0.267, 0.267))
    doc.page.y -= 20
    doc.spacer(12)

    title = (f"[{original_filename}] Transcript" if original_filename
             else "Transcript")
    for ln in _wrap(title, 16, USABLE_W):
        doc.line(F_COUR_B, 16, ln)
    stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    doc.line(F_COUR_O, 12, f"Generated on {stamp}", rgb=(0.4, 0.4, 0.4))
    doc.spacer(24)

    for segment in re.split(r"\n\n|\r\n\r\n", transcript_text):
        segment = segment.strip()
        if not segment:
            continue
        m = re.match(r"(\[SPEAKER_[A-Z]\])(?:\s+(\d+\.\d+s\s+-\s+\d+\.\d+s))?",
                     segment)
        if m:
            speaker = m.group(1).replace("[SPEAKER_", "Speaker ").replace("]", ":")
            timestamp = m.group(2) or ""
            dialogue = segment[m.end():].strip()
            doc.line(F_COUR_B, 12, speaker)
            if timestamp:
                doc.line(F_COUR_O, 9, f"({timestamp})", indent=20,
                         rgb=(0.5, 0.5, 0.5))
            for raw in dialogue.split("\n"):
                if raw.strip():
                    for ln in _wrap(raw.strip(), 11, USABLE_W - 20):
                        doc.line(F_COUR, 11, ln, indent=20, leading=14)
            doc.spacer(6)
        else:
            for raw in segment.split("\n"):
                if raw.strip():
                    for ln in _wrap(raw.strip(), 11, USABLE_W - 20):
                        doc.line(F_COUR, 11, ln, indent=20, leading=14)
            doc.spacer(6)

    with open(output_path, "wb") as fh:
        fh.write(doc.render())
    return output_path
