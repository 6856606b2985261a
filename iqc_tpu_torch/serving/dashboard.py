"""The operator dashboard: one self-contained HTML page served at ``/``.

It polls the REST API and listens to the /ws WebSocket (with /events as the
Server-Sent Events fallback) for detection results and alerts.
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Industrial QC Vision — GPU</title>
<style>
 :root { --bg:#0f1419; --card:#1a2028; --accent:#4da3ff; --ok:#3ddc84;
         --warn:#ffc857; --bad:#ff5d5d; --text:#e6edf3; --dim:#8b98a5; }
 body { margin:0; font:14px/1.45 system-ui,sans-serif; background:var(--bg); color:var(--text); }
 header { padding:16px 24px; background:var(--card); display:flex; justify-content:space-between; align-items:center; }
 h1 { font-size:18px; margin:0; } h1 span { color:var(--accent); }
 #status-dot { width:10px; height:10px; border-radius:50%; background:var(--bad); display:inline-block; margin-right:6px; }
 main { padding:24px; max-width:1200px; margin:0 auto; }
 .tiles { display:grid; grid-template-columns:repeat(4,1fr); gap:16px; margin-bottom:24px; }
 .tile { background:var(--card); border-radius:10px; padding:16px; }
 .tile .v { font-size:26px; font-weight:600; } .tile .l { color:var(--dim); font-size:12px; }
 .row { display:grid; grid-template-columns:1fr 1fr; gap:16px; margin-bottom:24px; }
 .panel { background:var(--card); border-radius:10px; padding:16px; }
 .panel h2 { font-size:14px; margin:0 0 10px; color:var(--dim); }
 canvas { width:100%; height:180px; }
 #drop { border:2px dashed var(--dim); border-radius:10px; padding:32px; text-align:center; color:var(--dim); cursor:pointer; margin-bottom:24px; }
 #drop.hover { border-color:var(--accent); color:var(--accent); }
 .card { background:var(--card); border-radius:10px; padding:12px 16px; margin-bottom:10px; display:flex; gap:16px; align-items:center; }
 .grade { font-size:22px; font-weight:700; width:36px; text-align:center; }
 .gA{color:var(--ok)} .gB{color:#9be15d} .gC{color:var(--warn)} .gD{color:#ff9857} .gF{color:var(--bad)}
 .chip { background:#27303b; border-radius:12px; padding:2px 10px; margin-right:6px; font-size:12px; }
 .pass{color:var(--ok)} .fail{color:var(--bad)} .cond{color:var(--warn)}
 #feed div { padding:4px 0; border-bottom:1px solid #27303b; font-size:12px; color:var(--dim); }
</style>
</head>
<body>
<header>
  <h1>Industrial QC Vision <span>GPU</span></h1>
  <div><span id="status-dot"></span><span id="status-text">connecting…</span></div>
</header>
<main>
  <div class="tiles">
    <div class="tile"><div class="v" id="t-processed">0</div><div class="l">images processed</div></div>
    <div class="tile"><div class="v" id="t-throughput">—</div><div class="l">images / min</div></div>
    <div class="tile"><div class="v" id="t-latency">—</div><div class="l">avg latency (ms)</div></div>
    <div class="tile"><div class="v" id="t-queue">0</div><div class="l">queue depth</div></div>
  </div>
  <div id="drop">drop images here or click to upload — runs /api/batch_detect</div>
  <input type="file" id="file-input" multiple accept="image/*" style="display:none">
  <div class="row">
    <div class="panel"><h2>SPC — defects per image</h2><canvas id="spc" width="560" height="180"></canvas></div>
    <div class="panel"><h2>Defect distribution</h2><canvas id="dist" width="560" height="180"></canvas></div>
  </div>
  <div class="row">
    <div class="panel"><h2>Results</h2><div id="results"></div></div>
    <div class="panel"><h2>Live feed</h2><div id="feed"></div></div>
  </div>
  <div class="row" id="history-row" style="display:none">
    <div class="panel"><h2>Stored history <span id="hist-summary" style="font-weight:normal"></span></h2><div id="history"></div></div>
  </div>
</main>
<script>
const $ = id => document.getElementById(id);
const spcData = [], distCounts = {};
let processed = 0;

function drawSPC() {
  const c = $('spc'), ctx = c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  if (!spcData.length) return;
  const n = spcData.length, max = Math.max(3, ...spcData);
  const mean = spcData.reduce((a,b)=>a+b,0)/n;
  const ucl = mean + 3*Math.sqrt(Math.max(mean, 0.01));
  const y = v => c.height - 14 - (v/Math.max(max,ucl)) * (c.height-28);
  const x = i => 10 + i*(c.width-20)/Math.max(n-1,1);
  ctx.strokeStyle='#8b98a5'; ctx.setLineDash([4,4]);
  ctx.beginPath(); ctx.moveTo(10,y(mean)); ctx.lineTo(c.width-10,y(mean)); ctx.stroke();
  ctx.strokeStyle='#ff5d5d';
  ctx.beginPath(); ctx.moveTo(10,y(ucl)); ctx.lineTo(c.width-10,y(ucl)); ctx.stroke();
  ctx.setLineDash([]); ctx.strokeStyle='#4da3ff'; ctx.beginPath();
  spcData.forEach((v,i)=>{ i ? ctx.lineTo(x(i),y(v)) : ctx.moveTo(x(i),y(v)); });
  ctx.stroke();
  ctx.fillStyle='#4da3ff';
  spcData.forEach((v,i)=>{ ctx.beginPath(); ctx.arc(x(i),y(v),2.5,0,7); ctx.fill(); });
}

function drawDist() {
  const c = $('dist'), ctx = c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  const keys = Object.keys(distCounts);
  if (!keys.length) return;
  const max = Math.max(...Object.values(distCounts));
  const colors = {crack:'#ff5d5d',scratch:'#3ddc84',dent:'#4da3ff',discoloration:'#ffc857',contamination:'#c77dff'};
  const bw = (c.width-40)/keys.length;
  keys.forEach((k,i)=>{
    const h = (distCounts[k]/max)*(c.height-40);
    ctx.fillStyle = colors[k] || '#8b98a5';
    ctx.fillRect(20+i*bw+6, c.height-20-h, bw-12, h);
    ctx.fillStyle='#e6edf3'; ctx.font='11px sans-serif'; ctx.textAlign='center';
    ctx.fillText(k.slice(0,8), 20+i*bw+bw/2, c.height-6);
    ctx.fillText(distCounts[k], 20+i*bw+bw/2, c.height-26-h);
  });
}

function addResult(r) {
  processed += 1; $('t-processed').textContent = processed;
  const qa = r.quality_assessment || {};
  const grade = qa.quality_grade || '?';
  const status = qa.pass_fail_status || qa.pass_fail || '?';
  const dets = r.detections || [];
  spcData.push(dets.length); if (spcData.length > 50) spcData.shift();
  dets.forEach(d => { distCounts[d.class] = (distCounts[d.class]||0)+1; });
  drawSPC(); drawDist();
  const cls = status==='PASS'?'pass':(status==='FAIL'?'fail':'cond');
  const chips = dets.slice(0,6).map(d=>`<span class="chip">${d.class} ${(d.ensemble_confidence||d.confidence||0).toFixed(2)}</span>`).join('');
  const div = document.createElement('div');
  div.className='card';
  div.innerHTML = `<div class="grade g${grade}">${grade}</div>
    <div><div class="${cls}">${status}</div>
    <div>${r.filename||''} — ${dets.length} defect(s), ${(r.total_inference_time_ms||0).toFixed(0)} ms</div>
    <div>${chips}</div></div>`;
  const box = $('results'); box.prepend(div);
  while (box.children.length > 20) box.removeChild(box.lastChild);
}

$('drop').onclick = () => $('file-input').click();
$('drop').ondragover = e => { e.preventDefault(); $('drop').classList.add('hover'); };
$('drop').ondragleave = () => $('drop').classList.remove('hover');
$('drop').ondrop = e => { e.preventDefault(); $('drop').classList.remove('hover'); upload(e.dataTransfer.files); };
$('file-input').onchange = e => upload(e.target.files);

async function upload(files) {
  const fd = new FormData();
  for (const f of files) fd.append('images', f);
  try {
    const res = await fetch('/api/batch_detect', {method:'POST', body:fd});
    const data = await res.json();
    (data.batch_results || []).forEach(addResult);
  } catch (err) { feed('upload failed: ' + err); }
}

function feed(msg) {
  const div = document.createElement('div');
  div.textContent = new Date().toLocaleTimeString() + ' ' + msg;
  $('feed').prepend(div);
  while ($('feed').children.length > 30) $('feed').removeChild($('feed').lastChild);
}

async function poll() {
  try {
    const h = await (await fetch('/health')).json();
    $('status-dot').style.background = h.models_loaded ? 'var(--ok)' : 'var(--warn)';
    $('status-text').textContent = h.models_loaded ? 'operational' : 'demo mode';
    const s = await (await fetch('/api/stats')).json();
    $('t-queue').textContent = s.queue_size;
    const p = await (await fetch('/api/models/performance')).json();
    const st = p.performance_stats || {};
    if (st.average_time_ms) $('t-latency').textContent = st.average_time_ms.toFixed(0);
    if (st.throughput_images_per_second) $('t-throughput').textContent = (st.throughput_images_per_second*60).toFixed(0);
  } catch (e) {
    $('status-dot').style.background='var(--bad)'; $('status-text').textContent='offline';
  }
}
setInterval(poll, 5000); poll();

// Stored history (GET /api/results — storage layer; hidden when the
// server runs with storage.enabled=false and the route returns 503).
async function pollHistory() {
  try {
    const r = await fetch('/api/results?limit=20');
    if (r.status !== 200) return;   // storage disabled: keep panel hidden
    const data = await r.json();
    const s = await (await fetch('/api/results/summary')).json();
    $('history-row').style.display = '';
    $('hist-summary').textContent =
      ` — ${s.total_results} stored, pass rate ${(100*(s.pass_rate||0)).toFixed(1)}%`;
    $('history').innerHTML = (data.results || []).map(row =>
      `<div>${new Date(row.created*1000).toLocaleTimeString()} ` +
      `<b>${row.quality_grade||'—'}</b> ${row.pass_fail||''} — ` +
      `${row.total_defects} defect(s), ${(row.latency_ms||0).toFixed(0)} ms</div>`
    ).join('');
  } catch (e) {}
}
setInterval(pollHistory, 10000); pollHistory();

// Primary realtime channel: persistent bidirectional WebSocket (/ws), the
// Socket.IO equivalent; one-way SSE polling remains as the fallback.
let wsFailed = false, wsEverOpened = false;
function listenWS() {
  try {
    const ws = new WebSocket((location.protocol === 'https:' ? 'wss://' : 'ws://') + location.host + '/ws');
    ws.onopen = () => { wsEverOpened = true; ws.send(JSON.stringify({event: 'start_realtime'})); };
    ws.onmessage = (m) => {
      try { const e = JSON.parse(m.data); const d = e.data || {};
        feed(e.event + ': ' + (d.message || `grade ${d.quality_grade} ${d.pass_fail||''}`)); } catch(err){}
    };
    ws.onclose = () => {
      if (wsEverOpened) { setTimeout(listenWS, 2000); }        // reconnect WS
      else { wsFailed = true; setTimeout(listen, 1000); }      // downgrade to SSE
    };
    ws.onerror = () => { ws.close(); };
  } catch (e) { wsFailed = true; listen(); }
}
function listen() {
  if (!wsFailed) { listenWS(); return; }
  fetch('/events?timeout=25&max=50').then(r => r.text()).then(text => {
    text.split('\\n\\n').forEach(block => {
      const ev = (block.match(/^event: (.*)$/m)||[])[1];
      const data = (block.match(/^data: (.*)$/m)||[])[1];
      if (ev && data) {
        try { const d = JSON.parse(data);
          feed(ev + ': ' + (d.message || `grade ${d.quality_grade} ${d.pass_fail||''}`)); } catch(e){}
      }
    });
    setTimeout(listen, 500);
  }).catch(() => setTimeout(listen, 5000));
}
listen();
</script>
</body>
</html>
"""
